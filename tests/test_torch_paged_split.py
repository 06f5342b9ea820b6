"""The split-and-merge arithmetic of the paged-decode (K1) and block-verify
(K2) kernels, held on the CPU.

`csrc/paged_attention.cu` cuts each slot's pages into splits, one thread
block each, that write per-row partials (m, l, acc) which a merge kernel
combines; with bf16 queries p goes to the tensor cores as bf16 values.
`paged_attention_split_emulation` repeats that arithmetic in plain PyTorch.
Here it is held against the JAX Pallas kernels it replaces (run in
interpret mode, as `tests/test_paged_kernel.py` runs them) and against the
plain version within f32 atol 2e-5 (the sides sum the same fp32 products in
another order), and at `chip_smoke.py`'s kernel shape against its bf16 limit
(atol 2e-3 + rtol 1e-2, element by element), which a split left out must
break. The kernels themselves are held to the plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from accelerate_tpu.ops import quantization as jq
from accelerate_tpu.ops.paged_attention import (
    paged_decode_attention as jax_decode,
    paged_verify_attention as jax_verify,
)
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.ops import quantization as pq
from accelerate_tpu_torch.ops.flash_common import NEG_INF

F32_ATOL = 2e-5
POOLS = ["f32", "int8", "fp8_e4m3"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: parity at 2e-5 is flaky on two."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_case(seed, s, page_size, B=3, hq=4, hkv=2, D=16, P=8):
    """Shuffled pages, GQA 4/2 and three slots: one live page (the rest of
    its table at the poisoned scratch page 0), a block ending mid-slot, and
    one ending at the slot's last column."""
    rng = np.random.default_rng(seed)
    N = B * P + 1
    L = P * page_size
    k = rng.normal(size=(N, page_size, hkv, D)).astype(np.float32)
    v = rng.normal(size=(N, page_size, hkv, D)).astype(np.float32)
    k[0], v[0] = 1e4, 1e4
    table = rng.permutation(np.arange(1, N)).reshape(B, P).astype(np.int32)
    table[0, 1:] = 0
    start = np.array([0, L // 2 + 1, L - s])
    pos = (start[:, None] + np.arange(s)[None, :]).astype(np.int32)
    q = rng.normal(size=(B, s, hq, D)).astype(np.float32)
    return q, k, v, table, pos


@functools.lru_cache(maxsize=None)
def _case(s, page_size, pool):
    """The numpy case as JAX arrays and torch tensors on the same values (a
    quantized pool: the same codes and scales), and JAX's Pallas output."""
    q, k, v, table, pos = _numpy_case(10 * s + page_size, s, page_size)
    jargs = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), jnp.asarray(pos)]
    targs = [torch.as_tensor(x) for x in (q, k, v, table, pos)]
    jscales, tscales = {}, {}
    if pool != "f32":
        jspec = jq.kv_quant_spec(pool)
        (kq, ks), (vq, vs) = jq.quantize_kv_pages(jargs[1], jspec), jq.quantize_kv_pages(jargs[2], jspec)
        jargs[1:3] = kq, vq
        jscales = dict(k_scale=ks, v_scale=vs)

        def to_torch(codes):
            arr = np.array(codes)
            return torch.as_tensor(arr) if pool == "int8" else torch.as_tensor(arr.view(np.uint8)).view(pq.E4M3)

        targs[1:3] = to_torch(kq), to_torch(vq)
        tscales = dict(k_scale=torch.as_tensor(np.array(ks)), v_scale=torch.as_tensor(np.array(vs)))
    fn = jax_decode if s == 1 else jax_verify
    expect = np.asarray(fn(*jargs, **jscales))
    return tuple(targs), tscales, expect


@pytest.mark.parametrize("split_pages", [2, 3], ids=["split-divides-slot", "split-ragged"])
@pytest.mark.parametrize("page_size", [4, 16])
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("s", [1, 5])
def test_emulation_matches_jax_pallas_and_plain_f32(s, pool, page_size, split_pages):
    """f32 queries: per-split partials and the merge give JAX's Pallas
    output and the plain version's within 2e-5, with splits that divide the
    8-page slot (2 pages) or leave a ragged last split (3 pages)."""
    args, scales, expect = _case(s, page_size, pool)
    got = pa.paged_attention_split_emulation(*args, **scales, split=split_pages * page_size)
    np.testing.assert_allclose(got.numpy(), expect, atol=F32_ATOL, rtol=0)
    ref = pa.paged_attention_reference(*args, **scales)
    torch.testing.assert_close(got, ref, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("pool", POOLS)
def test_split_without_a_visible_key_contributes_nothing(pool):
    """A verify block straddling a split boundary: the rows that end before
    it get m = NEG_INF, l = 0 and acc = 0 from the later split, and garbage
    in that split's columns (invisible to them) leaves their output
    bit-for-bit unchanged while the rows that see it move."""
    page_size, split = 4, 8
    args, scales, _ = _case(5, page_size, pool)
    q, k, v, table, pos = args
    pos = pos.clone()
    pos[1] = torch.arange(split - 3, split + 2)  # rows 0-2 end in split 0, rows 3-4 in split 1
    m, l, acc, ran = pa.split_partials(q, k, v, table, pos, **scales, split=split)
    assert ran[1, :2].all() and not ran[1, 2:].any()
    assert (m[1, :, :3, :, 1] == NEG_INF).all() and (l[1, :, :3, :, 1] == 0).all()
    assert (acc[1, :, :3, :, 1] == 0).all() and (l[1, :, 3:, :, 1] > 0).all()
    base = pa.paged_attention_split_emulation(q, k, v, table, pos, **scales, split=split)
    spoiled_k, spoiled_v = k.clone(), v.clone()
    for page in table[1, split // page_size: 2 * split // page_size]:  # fp8 has no flip: index
        spoiled_k[page] = spoiled_k[page][torch.arange(page_size - 1, -1, -1)]
        spoiled_v[page] = spoiled_v[page][..., torch.arange(k.shape[-1] - 1, -1, -1)]
    got = pa.paged_attention_split_emulation(q, spoiled_k, spoiled_v, table, pos, **scales, split=split)
    assert torch.equal(got[1, :3], base[1, :3])
    assert not torch.equal(got[1, 3:], base[1, 3:])
    torch.testing.assert_close(got, pa.paged_attention_reference(q, spoiled_k, spoiled_v, table, pos, **scales),
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("s", [1, 5])
def test_inactive_slots_are_finite_and_the_poison_changes_nothing(s, pool):
    """Slots whose table points only at the poisoned scratch page (an
    inactive slot) come out finite, and another poison value changes no
    output of slot 1, whose table never points at it (slot 0's verify
    block reaches its second page, which is the scratch page)."""
    args, scales, _ = _case(s, 4, pool)
    q, k, v, table, pos = args
    table, pos = table.clone(), pos.clone()
    table[2] = 0
    pos[2] = torch.arange(s)
    out = pa.paged_attention_split_emulation(q, k, v, table, pos, **scales, split=8)
    assert torch.isfinite(out).all()
    repoisoned_k, repoisoned_v = k.clone(), v.clone()
    rescaled = {name: sc.clone() for name, sc in scales.items()}
    if pool == "f32":
        repoisoned_k[0], repoisoned_v[0] = -3e4, 7e3
    else:  # the scratch page's codes are all alike: change what they mean
        rescaled["k_scale"][0] *= -3.0
        rescaled["v_scale"][0] *= 0.7
    again = pa.paged_attention_split_emulation(q, repoisoned_k, repoisoned_v, table, pos, **rescaled, split=8)
    assert torch.equal(again[1], out[1]) and not torch.equal(again[2], out[2])
    assert torch.isfinite(again).all()


@functools.lru_cache(maxsize=None)
def _kernel_shape_case(kind, pool):
    """`chip_smoke.py`'s K1/K2 inputs at its kernel shape (Llama-1B's
    attention: 8 slots of up to 2048 tokens, pages of 16), bf16 queries over
    a bf16, int8 or fp8 pool, and the plain version's output."""
    s = 1 if kind == "decode" else chip_smoke.KERNEL_SHAPE["verify_s"]
    q, k, v, table, pos = chip_smoke.kernel_case(CPU, torch.float32, s, seed=11 + s, **chip_smoke.KERNEL_SHAPE)
    scales = {}
    if pool == "f32":
        k, v = k.bfloat16(), v.bfloat16()
    else:
        spec = pq.kv_quant_spec(pool)
        (k, ks), (v, vs) = pq.quantize_kv_pages(k, spec), pq.quantize_kv_pages(v, spec)
        scales = dict(k_scale=ks, v_scale=vs)
    args = (q.bfloat16(), k, v, table, pos)
    return args, scales, pa.paged_attention_reference(*args, **scales)


def _limit(got, ref):
    return chip_smoke.limit_report(got, ref, atol=chip_smoke.BF16_ATOL, rtol=chip_smoke.BF16_RTOL)


KERNEL_SHAPE_CASES = [pytest.param(kind, pool, id=f"{kind}-{'bf16' if pool == 'f32' else pool}")
                      for kind in ("decode", "verify") for pool in POOLS]


@pytest.mark.parametrize("kind,pool", KERNEL_SHAPE_CASES)
def test_kernel_shape_bf16_arithmetic_stays_within_the_limit(kind, pool, record_property):
    """bf16 queries at the kernel shape: 256-token splits, p carried to the
    tensor cores as bf16 hi + lo, the output rounded to bf16, all within
    chip_smoke.py's unchanged limit with room to spare; the share of the
    limit used is reported."""
    args, scales, ref = _kernel_shape_case(kind, pool)
    report = _limit(pa.paged_attention_split_emulation(*args, **scales), ref)
    record_property("share_of_limit", report["share"])
    print(f"{kind} {pool}: share of the bf16 limit {report['share']:.4f} at {report['worst']}")
    assert report["broken"] == 0 and report["share"] < 0.75, report


@pytest.mark.parametrize("kind,pool", KERNEL_SHAPE_CASES)
def test_a_dropped_split_breaks_the_limit(kind, pool):
    """The same arithmetic with the second split of every slot left out, as a
    kernel that lost a block's partial would: the limit breaks, by far."""
    args, scales, ref = _kernel_shape_case(kind, pool)
    report = _limit(pa.paged_attention_split_emulation(*args, **scales, drop_split=1), ref)
    assert report["broken"] > 100 and report["share"] > 5, report


@pytest.mark.parametrize("pool", ["int8", "fp8_e4m3"])
def test_p_rounded_once_to_bf16_breaks_the_limit(pool):
    """Why p goes to the tensor cores as hi + lo: rounded once to bf16, p
    moves the verify output of a quantized pool past the limit (rows that
    see few keys, where the output is small)."""
    args, scales, ref = _kernel_shape_case("verify", pool)
    report = _limit(pa.paged_attention_split_emulation(*args, **scales, p_terms=1), ref)
    assert report["broken"] > 0, report


def test_split_length_comes_from_the_page_size():
    """The wrapper's split: whole tiles of whole pages, 256 tokens where the
    tile divides it, one tile where a page is larger; never a function of
    positions."""
    assert [pa.tile_tokens(ps) for ps in (1, 4, 12, 16, 64, 128)] == [64, 64, 60, 64, 64, 128]
    assert [pa.split_tokens(ps) for ps in (1, 4, 12, 16, 64, 128, 512)] == [256, 256, 240, 256, 256, 256, 512]
    for ps in (1, 4, 12, 16, 100, 128):
        assert pa.split_tokens(ps) % pa.tile_tokens(ps) == 0 and pa.tile_tokens(ps) % ps == 0
    assert pa.num_splits(128, 16, 256) == 8 and pa.num_splits(5, 16, 256) == 1 and pa.num_splits(17, 16, 256) == 2
